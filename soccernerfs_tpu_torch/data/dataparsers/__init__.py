"""Dataparser registry: the names of the JAX package's ``DATAPARSERS``
for the parsers the port has."""
from soccernerfs_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.soccer import (
    BroadcaststyleDataParserConfig,
    CloseupDataParserConfig,
    DynamicDataParserConfig,
    StadiumDataParserConfig,
    StadiumwideDataParserConfig,
)

DATAPARSERS = {
    "blender-data": BlenderDataParserConfig,
    "stadium-data": StadiumDataParserConfig,
    "closeup-data": CloseupDataParserConfig,
    "broadcaststyle-data": BroadcaststyleDataParserConfig,
    "stadiumwide-data": StadiumwideDataParserConfig,
    "dynamic-data": DynamicDataParserConfig,
}

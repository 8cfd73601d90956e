"""Dataparser registry: the names of the JAX package's ``DATAPARSERS``
for the parsers the port has."""
from soccernerfs_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.dnerf import DNeRFDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.hypernerf import HyperNeRFDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.nerfstudio import NerfstudioDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.sitcoms3d import Sitcoms3DDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.soccer import (
    BroadcaststyleDataParserConfig,
    CloseupDataParserConfig,
    DynamicDataParserConfig,
    StadiumDataParserConfig,
    StadiumwideDataParserConfig,
)

DATAPARSERS = {
    "nerfstudio-data": NerfstudioDataParserConfig,
    "blender-data": BlenderDataParserConfig,
    "stadium-data": StadiumDataParserConfig,
    "closeup-data": CloseupDataParserConfig,
    "broadcaststyle-data": BroadcaststyleDataParserConfig,
    "stadiumwide-data": StadiumwideDataParserConfig,
    "dynamic-data": DynamicDataParserConfig,
    "hypernerf-data": HyperNeRFDataParserConfig,
    "dnerf-data": DNeRFDataParserConfig,
    "sitcoms3d-data": Sitcoms3DDataParserConfig,
}

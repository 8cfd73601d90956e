"""Dataparser registry: the JAX package's ``DATAPARSERS``, the same names
in the same order (the ``snt-train`` subcommands)."""
from soccernerfs_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.dnerf import DNeRFDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.hypernerf import HyperNeRFDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.instant_ngp_data import (
    InstantNGPDataParserConfig,
)
from soccernerfs_tpu_torch.data.dataparsers.minimal import MinimalDataParserConfig
from soccernerfs_tpu_torch.data.dataparsers.misc_parsers import (
    ARKitScenesDataParserConfig,
    DycheckDataParserConfig,
    NuScenesDataParserConfig,
    PhototourismDataParserConfig,
    ScanNetDataParserConfig,
    SDFStudioDataParserConfig,
)
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
    "minimal-parser": MinimalDataParserConfig,
    "instant-ngp-data": InstantNGPDataParserConfig,
    "sitcoms3d-data": Sitcoms3DDataParserConfig,
    "phototourism-data": PhototourismDataParserConfig,
    "dycheck-data": DycheckDataParserConfig,
    "sdfstudio-data": SDFStudioDataParserConfig,
    "scannet-data": ScanNetDataParserConfig,
    "arkitscenes-data": ARKitScenesDataParserConfig,
    "nuscenes-data": NuScenesDataParserConfig,
}

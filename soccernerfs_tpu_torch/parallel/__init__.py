"""Data parallelism across devices and machines (counterpart of
soccernerfs_tpu/parallel): see ``mesh``."""

"""A small copy of each cell for the CPU tests (the same code paths, the
configuration's widths cut)."""

CELL = {"rays": 64, "pool": 8, "camera": {"height": 27, "width": 48, "focal": 40.0},
        "check_pixels": 256, "chunk": 1024, "trace_units": 2, "warmup_steps": 2}
CONFIG = {
    "k-planes": {
        "spacetime_resolution": [8, 8, 8, 4], "multiscale_res": [1, 2],
        "proposal_net_args_list": [{"feature_dim": 8, "resolution": [8, 8, 8, 4]},
                                   {"feature_dim": 8, "resolution": [16, 16, 16, 4]}],
        "num_proposal_samples_per_ray": [16, 8], "num_nerf_samples_per_ray": 8,
        "eval_num_rays_per_chunk": 1024},
    "nerfplayer-nerfacto": {
        "num_levels": 4, "log2_hashmap_size": 12, "temporal_dim": 8,
        "proposal_net_args_list": [
            {"hidden_dim": 16, "log2_hashmap_size": 10, "max_res": 32, "num_levels": 2,
             "temporal_dim": 4},
            {"hidden_dim": 16, "log2_hashmap_size": 10, "max_res": 64, "num_levels": 2,
             "temporal_dim": 4}],
        "num_proposal_samples_per_ray": [16, 8], "num_nerf_samples_per_ray": 8},
}
TINY = {"config": CONFIG["k-planes"], **CELL}


def tiny(cell: str) -> dict:
    """The overrides of ``cell``'s small copy."""
    from nerfbench.harness import spec

    return {"config": CONFIG[spec.workload(cell)["entry"]["config"]], **CELL}

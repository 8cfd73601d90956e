"""K-Planes temporal-resolution sweep
(counterpart of experiments/kp_temporal_res.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("kp_temporal_res")

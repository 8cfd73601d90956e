"""Spatial-resolution sweep of the K-Planes base grid
(counterpart of experiments/sp_res_kp.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("sp_res_kp")

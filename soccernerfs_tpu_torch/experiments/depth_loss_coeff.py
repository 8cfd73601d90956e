"""Depth-loss coefficient sweep on broadcast-style scenes
(counterpart of experiments/depth_loss_coeff.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("depth_loss_coeff")

"""K-Planes multiscale-resolution sweep on the Stadium scene (paper
section 5.3.5; its third run trains F = 24 at scales 1..32)
(counterpart of experiments/kp_res_study.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("kp_res_study")

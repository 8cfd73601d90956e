"""Space-TV regulariser weight sweep
(counterpart of experiments/kp_spacetv.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("kp_spacetv")

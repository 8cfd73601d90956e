"""Sparse-transients regulariser weight sweep
(counterpart of experiments/kp_sparsetransients.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("kp_sparsetransients")

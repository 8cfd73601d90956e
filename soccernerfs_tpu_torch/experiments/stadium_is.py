"""Importance-sampling ratio and range sweep on the Stadium scene
(counterpart of experiments/stadium_is.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("stadium_is")

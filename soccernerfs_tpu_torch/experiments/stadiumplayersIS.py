"""Importance-sampling ratio sweep on StadiumPlayers
(counterpart of experiments/stadiumplayersIS.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("stadiumplayersIS")

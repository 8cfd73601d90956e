"""Close-up training cameras on stadium-wide
(counterpart of experiments/stadiumplayers_closeup.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("stadiumplayers_closeup")

"""Number-of-training-cameras sweep
(counterpart of experiments/stadiumplayers_nb_cams.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("stadiumplayers_nb_cams")

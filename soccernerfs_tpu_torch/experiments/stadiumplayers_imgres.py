"""Image-resolution sweep, players subset
(counterpart of experiments/stadiumplayers_imgres.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("stadiumplayers_imgres")

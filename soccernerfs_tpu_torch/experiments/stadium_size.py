"""Scene-box size sweep
(counterpart of experiments/stadium_size.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("stadium_size")

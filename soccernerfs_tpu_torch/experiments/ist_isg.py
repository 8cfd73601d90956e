"""IST and ISG combinations on the Stadium scene
(counterpart of experiments/ist_isg.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("ist_isg")

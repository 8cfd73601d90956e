"""ISG gamma sweep against IST on the Stadium scene
(counterpart of experiments/isg.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("isg")

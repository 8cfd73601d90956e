"""Full NeRFPlayer on the synthetic stadium-wide scene
(counterpart of experiments/np_synth_paderborn.py; the sweep: sweeps.DRIVERS)."""
from soccernerfs_tpu_torch.experiments.sweeps import main

if __name__ == "__main__":
    main("np_synth_paderborn")

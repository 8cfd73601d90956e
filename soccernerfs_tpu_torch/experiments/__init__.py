"""The paper's sweeps on the port (counterpart of the repository's
``experiments/``): ``snt_experiment.Experiment`` runs
``soccernerfs_tpu_torch.scripts.{train,render,eval}`` once per parameter
set, and each driver module (``python -m
soccernerfs_tpu_torch.experiments.<driver>``) runs one sweep of
``sweeps.DRIVERS``."""

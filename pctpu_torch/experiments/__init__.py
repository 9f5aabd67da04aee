"""Experiments of the port on the card: the shared bench scene and the
ports of pctpu's ``scripts/exp_*.py`` (run as ``python -m
pctpu_torch.experiments.<name>``)."""

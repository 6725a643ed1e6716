"""The port's tools, each run as ``python -m
neuralbarkcalculator_tpu_torch.tools.<name>``: the serving benchmark and
soak, data curation, and the structured synthetic images they use."""

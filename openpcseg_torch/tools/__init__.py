"""The port's tool scripts: the golden-run summary, the SemanticKITTI and
Waymo visualizers, and the Waymo Open preprocessors. Each runs as
``python -m openpcseg_torch.tools.<name>``."""

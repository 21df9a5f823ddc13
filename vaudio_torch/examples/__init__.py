"""Runnable examples of the port (copies of the repository's ``examples/``):
``python -m vaudio_torch.examples.<walkthrough|baseline_configs|
serving_pod>``.  Each runs on the card; ``VAUDIO_PLATFORM=cpu`` runs it on
the CPU (the CLI's rule, :func:`vaudio_torch.cli.platform_device`)."""

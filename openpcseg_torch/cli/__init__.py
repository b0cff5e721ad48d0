"""Command-line entry points: ``python -m openpcseg_torch.cli.train``,
``.infer`` and ``.golden_run``. Each has a ``main(argv=None)`` that can also
be called in-process."""

"""Per-layer metric readers, each a file with ``read(ctx)``: ``<metric>.py``,
or ``<base>.py`` for the metrics whose names are ``<base>.<suffix>``
(``harness.reader_path``), and the frozen arithmetic they share: ``_peaks.py``
(datasheet peaks by card name), ``_groups.py`` (kernel-name groups) and
``_counts.py`` (allowed pairs, the attention bound, model FLOPs)."""

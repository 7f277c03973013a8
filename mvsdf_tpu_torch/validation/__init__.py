"""Trained-quality and multi-scan entry points: ``full_training`` (the
600-epoch three-phase capstone on the shaded synthetic scene),
``quality_pin`` (its fixed-seed quality gate) and ``dtu_suite`` (train,
evaluate and trim a set of scans through the port's CLIs)."""

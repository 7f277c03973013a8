"""Cell kinds: one module per kind, found by the workload file's ``kind``."""

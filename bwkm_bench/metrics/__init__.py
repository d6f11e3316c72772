"""One reader a metric: ``<metric>.py`` has ``read(record) -> float | None``."""

"""Framework-free glue shared by the port: registry and config."""

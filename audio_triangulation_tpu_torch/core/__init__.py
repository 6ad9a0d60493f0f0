"""Configuration and array geometry."""

"""The deterministic synthetic token stream training reads."""

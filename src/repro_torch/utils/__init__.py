"""Parameter layout and device helpers."""

"""Launch-side helpers and the training and serving CLIs of the port."""

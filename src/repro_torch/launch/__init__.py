"""Launch-side helpers and the training CLI of the port."""

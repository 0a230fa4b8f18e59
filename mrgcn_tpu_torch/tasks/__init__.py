"""Training and evaluation tasks of the port."""

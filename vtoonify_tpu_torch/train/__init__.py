"""See the module docstrings; the layout mirrors vtoonify_tpu."""

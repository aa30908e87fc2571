"""Research and measurement scripts of the port, run as modules
(``python -m ecad_tpu_torch.scripts.<name>``)."""

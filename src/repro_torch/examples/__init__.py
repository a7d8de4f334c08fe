"""Example drivers of the port, run as modules
(``python -m repro_torch.examples.train_fl_100m``)."""

"""On-device data generation of the port."""
from repro_torch.data.ondevice import make_linear_datagen, make_token_datagen

__all__ = ["make_linear_datagen", "make_token_datagen"]

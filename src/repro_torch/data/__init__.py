"""Data of the port: on-device synthetic batch generators for the fleet
engine, and numpy copies of the reference's synthetic LM source, its
federated partitions and its batch pipeline."""
from repro_torch.data.ondevice import make_linear_datagen, make_token_datagen
from repro_torch.data.partition import dirichlet_partition, shard_partition
from repro_torch.data.pipeline import FederatedLoader, batch_iterator
from repro_torch.data.synthetic import SyntheticLMDataset

__all__ = ["make_linear_datagen", "make_token_datagen", "SyntheticLMDataset",
           "dirichlet_partition", "shard_partition", "FederatedLoader",
           "batch_iterator"]

"""Command-line entry points of the port: ``python -m
repro_torch.launch.train`` trains a config federated through the flat
engine, or with ``--cluster`` through the trainer (``launch/steps.py``)
on a mesh of members (``launch/mesh.py``, ``members.py``, the sharding
rules of ``sharding.py``); ``python -m repro_torch.launch.serve`` prefills
prompts and decodes greedily with KV and recurrent caches; ``python -m
repro_torch.launch.dryrun`` runs one member's step of every case under fake
tensors and records its bytes, flops and wire (``specs.py``,
``hlo_analysis.py``, ``reanalyze.py``)."""

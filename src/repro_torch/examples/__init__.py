"""The walk-through examples of ``examples/``, ported, run as modules
(``python -m repro_torch.examples.<name>``): ``quickstart``,
``private_fl``, ``hierarchical_fl``, ``decentralized_gossip``,
``fog_hybrid``, ``wireless_scheduling_sim`` and ``train_fl_100m``;
``problems`` holds the LM problem four of them share."""

"""HumanRF scene representation: 4D decomposition, MLPs, proposal field."""

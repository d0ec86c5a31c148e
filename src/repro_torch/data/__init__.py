"""Data substrate of the port: the heavy-tailed prompt-conditioned length
laws, the calibrated Track-A scenario generators and the toy tokenizer
(NumPy copies of the reference's modules)."""

from repro_torch.data.synthetic import ScenarioData, make_scenario  # noqa: F401

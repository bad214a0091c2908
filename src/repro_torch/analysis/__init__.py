"""Hardware constants of the card the port runs on."""
from repro_torch.analysis import hw_specs  # noqa: F401

"""Reverse-diffusion sampling: jitted scan loop + guidance transforms."""

from svdd.sampling import sampler  # noqa: F401
from svdd.sampling import guidance  # noqa: F401

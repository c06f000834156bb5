"""Flax model zoo: denoiser backbones and value/reward trunks.

Reference inventory (SURVEY.md §2): CNN (models/dnaconv.py), DiT
(models/dit.py), DiMamba (models/dimamba.py), AR (models/autoregressive.py)
backbones; Enformer / ConvGRU value trunks (Enformer.py); EMA (models/ema.py).
"""

from svdd.models import cnn  # noqa: F401
from svdd.models import ema  # noqa: F401

"""One-way importers: reference torch checkpoints -> flax param trees.

The reference ships torch-pickle checkpoints in three formats
(SURVEY.md §5): Lightning diffusion ckpts, grelu LightningModel reward
oracles, and hand-rolled value-net dicts (trainer.py:73-96). These
importers map their state-dict layouts onto svdd's flax modules so
reference users can carry weights across. Validated by numerical
parity tests against the reference architectures run under torch-CPU
(tests/test_importers.py).
"""

from svdd.importers.cnn import import_cnn_params  # noqa: F401
from svdd.importers.convgru import (  # noqa: F401
    import_bidirectional_gru, import_convgru_value_model, import_gru_cell)
from svdd.importers.dit import import_dit_params  # noqa: F401
from svdd.importers.enformer import (  # noqa: F401
    import_enformer_value_model)

"""svdd — JAX framework for Soft Value-based Decoding in Diffusion
models (SVDD).

A from-scratch rebuild of the capabilities of the masa-ue/SVDD reference
(arXiv:2408.08252):

  * masked discrete diffusion (MDLM, SUBS/D3PM/SEDD parameterizations)
  * reward-guided decoding: SVDD-MC, SVDD-PM (Tweedie), TDS, DPS,
    classifier guidance — all fused into a single jitted ``lax.scan``
    reverse process with the candidate dimension folded into the batch
  * value-network training (MC and CD-Q targets)
  * DNA-enhancer (Gosai/HepG2) and RNA 5'UTR (MRL) tasks

Reference layer map: SURVEY.md §1; capability checklist: SURVEY.md §7.4.
"""

from svdd import _vendor

# Every model is a flax.linen module; hosts without flax use the copy in
# svdd/_vendor.
_vendor.ensure_flax()

__version__ = "0.1.0"

from svdd import schedules  # noqa: F401,E402
from svdd import mdlm  # noqa: F401,E402

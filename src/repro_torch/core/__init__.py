"""The paper's contribution: LRD as an acceleration technique.

* :mod:`repro_torch.core.svd` -- the decomposition (paper Eq. 1-3).
* :mod:`repro_torch.core.rank_selection` -- Algorithm 1 and tile
  alignment (§2.1).
* :mod:`repro_torch.core.cost_model` -- the H100 timer behind Algorithm 1
  and the timer measured on the card.
* :mod:`repro_torch.core.freezing` -- factor freezing (§2.2).
* :mod:`repro_torch.core.merging` -- layer merging incl. QK/VO products
  (§2.3).
* :mod:`repro_torch.core.branching` -- block-diagonal branched LRD (§2.4).
* :mod:`repro_torch.core.tucker` -- Tucker-2 of conv weights (Eq. 4-7).
* :mod:`repro_torch.core.surgery` -- the whole-model decomposition.
"""
from repro_torch.core.svd import (  # noqa: F401
    SVDFactors, svd_decompose, randomized_svd, decompose_auto,
    ratio_rank, compression_of_rank, energy_rank,
)
from repro_torch.core.rank_selection import (  # noqa: F401
    ORG, RankDecision, algorithm1, align_rank, select_rank, max_branches,
)
from repro_torch.core.branching import (  # noqa: F401
    BranchedConvFactors, BranchedFactors, branch_svd, branch_tucker,
    quantize_ranks,
)
from repro_torch.core.tucker import (  # noqa: F401
    TuckerFactors, tucker2_decompose, ratio_ranks,
)
from repro_torch.core.merging import (  # noqa: F401
    MergedAttnFactors, merge_attention, merge_linear,
)
from repro_torch.core.freezing import trainable_mask  # noqa: F401
from repro_torch.core.surgery import (  # noqa: F401
    SurgeryReport, LayerDecision, decompose_model, classify_path,
)
from repro_torch.analysis import hw_specs  # noqa: F401

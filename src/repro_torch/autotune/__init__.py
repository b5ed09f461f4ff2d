"""Empirical-roofline autotuner: measure the knob grid, fit a cost model,
cache the winners.

The paper's method is a design-space search: per-layer reuse factors are
chosen so measured initiation intervals balance against a resource model
(Sec. IV).  The port's knobs (``chunk_len``, ``block_b``, ``fuse_gates``
and the mixed backend's ``split``) follow the same flow:

    space.py   per-backend knob grids, legality from the ``core.backends``
               capability table (the sweep never proposes a plan
               ``plan_stack`` would refuse)
    sweep.py   measured min-of-k timing of the grid per (geometry, batch,
               dtype, backend) through the serving call, as JSONL records
    model.py   roofline fit over those records, FLOPs and bytes counted
               from the kernels' shapes (``stack_kernel_costs``)
    cache.py   versioned tuned-plan store keyed by (geometry, backend,
               dtype, device fingerprint), read by
               ``plan_stack(tune="cached")``

``python -m repro_torch.launch.tune`` runs a sweep and fills the cache.
"""

from .cache import (  # noqa: F401
    CACHE_VERSION,
    TunedPlanCache,
    canonical_weight_dtype,
    device_fingerprint,
    get_cache,
    lookup_tuned,
    set_cache,
)
from .model import (  # noqa: F401
    H100_SXM,
    HardwareModel,
    RooflineFit,
    attach_costs,
    config_costs,
    fit_roofline,
    predict_pack_bytes,
    roofline_terms_from_counts,
    stack_kernel_costs,
)
from .space import KnobPoint, knob_space  # noqa: F401
from .sweep import (  # noqa: F401
    SweepCase,
    best_record,
    default_record,
    read_jsonl,
    run_sweep,
    sweep_case,
    write_jsonl,
)

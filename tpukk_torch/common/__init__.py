from .errors import TpuKKError, check
from .timing import chain_time_slope
from .tracing import annotate, profile_region, region_name
from .types import (default_device, default_offset, default_ordinal,
                    default_scalar, supported_scalars)
# utils.permute is not re-exported: the name belongs to the submodule
# common.permute (static permutation plans, K5)
from .utils import (cdiv, exclusive_scan, inclusive_scan, inverse_permutation,
                    permute_via_sort, round_up)

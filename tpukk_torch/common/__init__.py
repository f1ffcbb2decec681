from .errors import TpuKKError, check
from .timing import chain_time_slope
from .tracing import annotate, profile_region, region_name
from .types import (default_device, default_offset, default_ordinal,
                    default_scalar, supported_scalars)
from .utils import cdiv, exclusive_scan, inclusive_scan, inverse_permutation, round_up

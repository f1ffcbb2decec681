from .arith_traits import ArithTraits, arith_traits, is_complex, mag_dtype
from .controls import Controls, eager_initialize, print_configuration
from .perf_archive import MetricResult, PerfArchive
from .errors import TpuKKError, check, check_rank, check_same_dtype
from .timing import chain_time_slope, sync_fetch
from .tracing import annotate, profile_region, region_name, trace
from .types import (default_device, default_offset, default_ordinal,
                    default_scalar, result_dtype, supported_scalars)
# utils.permute is not re-exported: the name belongs to the submodule
# common.permute (static permutation plans, K5)
from .utils import (cdiv, exclusive_scan, inclusive_scan, inverse_permutation,
                    permute_via_sort, round_up, segment_offsets_from_sizes, sizes_from_offsets)

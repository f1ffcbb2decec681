from .coarsen import CoarsenHeuristic, coarsen, explicit_coarsen, heavy_edge_matching
from .coloring import ColoringAlgorithm, color_sets, graph_color, graph_color_d2, verify_coloring
from .mis2 import graph_mis2, graph_mis2_aggregate, graph_mis2_coarsen
from .ordering import permute_matrix, rcb, rcm, rcm_plain
from .triangle import (TrianglePlan, build_triangle_plan, triangle_count,
                       triangle_count_device, triangle_count_per_row)

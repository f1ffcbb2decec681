from .ordering import permute_matrix, rcb, rcm, rcm_plain

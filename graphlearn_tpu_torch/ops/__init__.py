from .draws import hash_draws
from .fused_sample import sample_one_hop_fused
from .gather_rows import gather_rows, gather_rows_plain
from .neighbor import (OneHopResult, default_window, lookup_degree,
                       sample_one_hop)

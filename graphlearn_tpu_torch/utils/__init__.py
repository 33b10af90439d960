from .device import resolve_device
from .padding import (INVALID_ID, max_sampled_nodes, next_power_of_two,
                      round_up)
from .tensor import convert_to_array, id2idx
from .topo import coo_to_csr, csr_to_coo, ptr2ind

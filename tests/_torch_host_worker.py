"""Process targets and data for the port's host-runtime tests, kept out
of the test modules so a spawned child imports neither JAX nor the
tests' fixtures."""
import os

import numpy as np


def produce(ch, n_msgs):
  """Send ``n_msgs`` numbered messages into channel ``ch``."""
  for i in range(n_msgs):
    ch.send({'ids': np.arange(i + 1, dtype=np.int64),
             'val': np.full((2, 3), float(i), np.float32)})


def ring(mod, n, d=4):
  """A ring with a long chord: node v -> v+1, v+2, 7v (mod n); feature
  row = the id; label = id % 4.  ``mod`` is either package's
  ``distributed`` (its `HostDataset`)."""
  rows = np.repeat(np.arange(n), 3)
  cols = np.stack([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n,
                   (np.arange(n) * 7) % n], 1).reshape(-1)
  feats = np.tile(np.arange(n, dtype=np.float32)[:, None], (1, d))
  return mod.HostDataset.from_coo(rows, cols, n, node_features=feats,
                                  node_labels=np.arange(n) % 4)


def sampling_server(port_q, n, jsonl, worker_plan):
  """A port sampling server over ``ring(n)``: its producer workers
  inherit ``worker_plan`` and the telemetry sink (set before the pool
  exists); serves until its client asks it to exit."""
  os.environ['GLT_FAULT_PLAN'] = worker_plan
  os.environ['GLT_TELEMETRY_JSONL'] = jsonl
  from graphlearn_tpu_torch import distributed as pdist
  from graphlearn_tpu_torch.telemetry import recorder
  recorder.enable(jsonl)
  srv = pdist.init_server(num_servers=1, num_clients=1, rank=0,
                          dataset=ring(pdist, n), host='127.0.0.1', port=0)
  port_q.put(srv.port)
  pdist.wait_and_shutdown_server(timeout=300)

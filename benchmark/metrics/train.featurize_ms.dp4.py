"""`train.featurize_ms` of the four-card training cell (rank 0), under a
name of its own, as the cell's other per-layer metrics: the featurising
thread shares the host's CPUs with the four ranks' dispatch."""

import os

from benchmark.harness import load_file

read = load_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "train.featurize_ms.py"),
                 "benchmark_metric_train_featurize_ms").read

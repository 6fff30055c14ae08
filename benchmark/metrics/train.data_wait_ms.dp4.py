"""`train.data_wait_ms` of the four-card training cell, under a name of its
own: that cell's runs spread far wider than one card's, so its
throughput has a bound of its own, and what moves it is named apart."""

import os

from benchmark.harness import load_file

read = load_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "train.data_wait_ms.py"),
                 "benchmark_metric_train_data_wait_ms").read

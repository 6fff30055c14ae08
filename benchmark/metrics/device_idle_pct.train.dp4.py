"""`device_idle_pct.train` of the four-card training cell, under a name of its
own: that cell's runs spread far wider than one card's, so its
throughput has a bound of its own, and what moves it is named apart."""

import os

from benchmark.harness import load_file

read = load_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "device_idle_pct.train.py"),
                 "benchmark_metric_device_idle_pct_train").read

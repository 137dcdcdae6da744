"""The benchmark harness of ``zlibes_tpu_torch``: loads a cell of
``BENCHMARK.json`` by name, makes its data from a seed, drives the port
through a measured window and judges what it returned."""

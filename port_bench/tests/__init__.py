"""CPU tests of the benchmark (``pytest port_bench/tests``); the tests
marked ``card`` run on a CUDA card and skip without one."""

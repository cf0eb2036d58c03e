"""One module per traffic kind, found by name: a traffic file's ``kind``
names ``gpu_bench/drivers/<kind>.py``, whose ``Driver(config, traffic,
seed, devices)`` builds the cell's inputs from the seed in ``setup()``
(warm-up included) on the cell's ``devices`` (one a card, in order),
runs one iteration a ``step(recorder)``, and hands the check its inputs
in ``check_inputs()``.

Each module also states what its CPU tests need, so that a new cell of
an existing kind needs no edit to a test: ``tiny(config, traffic)``,
the cell at a size a CPU test holds; ``TEST_SECONDS``, such a test's
window; ``ENTRY``, the (module, name) of the entry point that the timed
path calls through that module attribute and that the fault tests
replace; ``FAULTS``, the faults the tests plant in the kind."""

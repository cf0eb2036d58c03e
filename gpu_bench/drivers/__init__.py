"""One module per traffic kind, found by name: a traffic file's ``kind``
names ``gpu_bench/drivers/<kind>.py``, whose ``Driver(config, traffic,
seed, device)`` builds the cell's inputs from the seed in ``setup()``
(warm-up included), runs one iteration a ``step(recorder)``, and hands
the check its inputs in ``check_inputs()``."""

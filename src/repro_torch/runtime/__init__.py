"""Runtime layer of the port: topology, blocked transposes, streamed
exchange rounds, and the device and process-group probes. The one
gateway to ``torch.distributed``: no module outside ``runtime/`` calls it
(tests/test_torch_api.py::test_only_the_runtime_calls_torch_distributed).
"""

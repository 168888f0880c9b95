"""Device ms a trace in kernels that are not the port's own (plain
PyTorch and copies; the port's csrc kernels sit in an anonymous
namespace, PyTorch's in at::native)."""


def read(trace, session):
    return 1e3 * trace.device_s(lambda n: not trace.is_port(n)) / trace.units

def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card and nvcc (the port's hand-written kernels); "
        "skips on a host without them",
    )

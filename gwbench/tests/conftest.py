def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips with a reason where torch.cuda.is_available() is False",
    )

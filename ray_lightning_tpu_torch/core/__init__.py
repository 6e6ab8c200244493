"""Training core of the port: the module protocol, data, callbacks, the
fit loop and the trainer.  Exports the JAX package's ``core`` names, with
the port's callbacks, resolved on first use (``core.module`` is imported
by the modules the loop itself imports)."""

_EXPORTS = {
    "TrainModule": "module", "TpuModule": "module", "TrainState": "module",
    "TpuDataModule": "data", "ArrayDataset": "data", "NumpyLoader": "data",
    "RandomDataset": "data",
    "Callback": "callbacks", "ModelCheckpoint": "callbacks",
    "EarlyStopping": "callbacks", "CSVLogger": "callbacks",
    "ProfilerCallback": "callbacks", "DeviceStatsCallback": "callbacks",
    "StochasticWeightAveraging": "callbacks",
    "ExponentialMovingAverage": "callbacks",
    "FitConfig": "loop", "Trainer": "trainer",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Training core of the port: the module protocol, data, callbacks, the
fit loop and the trainer."""

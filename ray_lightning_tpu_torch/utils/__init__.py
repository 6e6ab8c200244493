"""Host utilities of the port: the state-stream checkpoint format and the
msgpack and treedef codecs under it."""

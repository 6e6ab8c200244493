"""The port's host control plane: length-prefixed frames over TCP
(``rpc.py``), the acknowledged queue the serving plane rides
(``queue.py``) and same-host payload segments on tmpfs (``shm.py``)."""

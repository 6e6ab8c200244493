"""The port's host control plane: length-prefixed frames over TCP
(``rpc.py``), the acknowledged queue the serving plane and the result
pump ride (``queue.py``), same-host payload segments on tmpfs
(``shm.py``), process actors (``actor.py``) and the local backend with its
object store (``backend.py``)."""

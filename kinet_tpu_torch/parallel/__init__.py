"""Scale-out over processes (port of ``kinet_tpu/parallel/``): the
("data", "model") mesh (``mesh.py``), tensor-parallel parameter shardings
(``tp.py``) and spatially parallel serving of one stream (``sp.py``)."""

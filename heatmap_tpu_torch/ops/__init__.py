"""Device operators of the port: the scatter segment reduce
(``sparse``), the CUDA segment-reduce kernel (``sparse_partitioned``)
and the sparse zoom pyramids built on them (``pyramid``)."""

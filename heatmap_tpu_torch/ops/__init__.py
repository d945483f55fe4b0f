"""Device operators of the port: the scatter segment reduce
(``sparse``), the CUDA segment-reduce kernel (``sparse_partitioned``),
the sparse and dense zoom pyramids (``pyramid``), window binning
(``histogram``) on its two CUDA kernels (``pallas_kernels``, the window
histogram, and ``partitioned``, the bucketed passes), and the Gaussian
splat (``splat``)."""

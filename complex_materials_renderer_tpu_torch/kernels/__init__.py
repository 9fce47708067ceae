"""The path-tracing kernel (K1) with its triangle tester (K2), the cluster
grid layout they read, and the nvcc build of their CUDA sources."""

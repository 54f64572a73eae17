"""Hand-written Hopper kernels of the port, each beside its plain version.

flash_attention.py -- causal/windowed/softcapped GQA attention forward
(CUDA C++ in csrc/flash_attention.cu). ops.py dispatches on the device.
"""

"""PyTorch/CUDA port of the Sparsified SGD with Memory system.

The JAX package ``repro`` beside this one is the reference: each module
here mirrors its counterpart's layout and names, and the port's tests hold
it against that module on the same inputs. This package imports neither
``jax`` nor anything of ``repro``. Its kernels are hand-written CUDA for
Hopper (``kernels/csrc``); plain tensor code is PyTorch. Entry points run
on CUDA unless the caller asks for the CPU, where each kernel's plain
version runs instead.
"""

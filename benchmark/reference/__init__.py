"""Plain float32 references of what the benchmark's cells produce.

Plain PyTorch on whatever device the caller gives: RevResNet encode and
decode, the global and the regional cWCT, SegFormer-B4's masks, the ADE20K
remaps and the 4K tiler. They import nothing of the program under test
and take only the weights and inputs the harness made; whatever the
program derives from them (packed weights, style factors, regions, remap
tables) is worked out again here.

Every convolution and matrix product goes through a precision hook
(`lowp.Exact`, the identity, or `lowp.Fp8`, which rounds both operands to
float8 e4m3 with a per-tensor scale): the second is the control that the
limits of `correct` were read against.
"""

"""The benchmark's plain reference: what ``correct`` is decided against.

``dp.scores`` is the 7-matrix affine-gap dynamic program of three sequences,
swept plane by plane in plain PyTorch over a batch of triplets; ``rescore``
scores an alignment column by column under the same rules.  Both work from
the configuration's scoring alone and import nothing of the program under
test.
"""

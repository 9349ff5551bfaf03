"""Batches and long triplets over several devices and processes (the port
of ``trialign/dist``): meshes, the halo and its traceback, sharded and
multi-process batches."""

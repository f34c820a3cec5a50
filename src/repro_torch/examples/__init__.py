"""The reference's examples on the port, one module each, run as
``python -m repro_torch.examples.<name>`` (the CUDA card by default,
``--device cpu`` for the CPU): ``quickstart``, ``coded_matmul_service``,
``autotune_service``, ``train_lm_coded`` and ``fault_tolerance``.  Each
prints the reference example's summary lines; importing one runs nothing.
"""

from tpu_mf.ops.sgd import sgd_batch_update, sgd_epoch  # noqa: F401

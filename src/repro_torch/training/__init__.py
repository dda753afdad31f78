"""Training on one card: AdamW and its schedules (``optimizer``), the train
step with microbatches and the data-parallel step (``train_loop``), gradient
compression for the data-parallel exchange (``compression``), checkpoints in
the reference's on-disk format (``checkpoint``), checkpoint-restart fault
recovery (``fault``) and GPipe stages (``pipeline``), over the parameter
trees of ``tree``."""

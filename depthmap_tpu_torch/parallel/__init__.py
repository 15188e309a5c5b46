"""Multi-device work: device lists, the (data, model) mesh, the Megatron
placement policy, the split of a batch over devices, and the sharded SILog
train step.

Port of ``depthmap_tpu/parallel/``: batches, Boost patches, Marigold
members and polylines rows ride a list of devices (``mesh.split_run``);
the train step splits its batch on the mesh's "data" axis and the ViT
blocks' attention heads and MLP widths on its "model" axis, with the
collectives written out (``torch.distributed``) where XLA inserted them.
"""

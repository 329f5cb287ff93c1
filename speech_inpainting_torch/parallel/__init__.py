"""Scale-out over torch.distributed: device meshes (mesh.py), the
multi-process runtime and its collectives (distributed.py), and tensor
parallelism for HuBERT (tp.py). Counterpart of
speech_inpainting_tpu/parallel/."""

from android_svo_tpu_torch.ops import pyramid, interp, detect

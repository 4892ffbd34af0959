"""``python -m batchai_retinanet_horovod_coco_tpu_torch.serve`` → the serve CLI."""

from batchai_retinanet_horovod_coco_tpu_torch.serve.frontend import main

if __name__ == "__main__":
    main()

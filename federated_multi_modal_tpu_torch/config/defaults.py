"""Default configuration tree (a copy of
``federated_multi_modal_tpu/config/defaults.py``, equal to it key for key,
so that one yaml or command line configures either package).

Reproduces the configuration surface the reference consumes: Dassl's
``get_cfg_default`` fields that the repo actually reads, plus the trainer
extensions added in the reference's ``train.py:83-138`` (``extend_cfg``):
TRAINER.{COOP,COCOOP,MAPLE,IVLP,VPT}, DATASET.SUBSAMPLE_CLASSES and the
FED node (NUM_CLIENTS/NUM_ROUNDS/LOCAL_EPOCHS, ``train.py:134-138``).

TPU-specific additions live under ``cfg.TPU`` (mesh shape, precision,
pallas toggles) and default to sensible single-chip values. The port keeps
their names and reads them so:

* ``TPU.ATTENTION_IMPL``: ``"auto"`` is the kernel routes (``"pallas"``) on
  CUDA and the plain formulation (``"xla"``) on the CPU;
* ``TPU.TEXT_PACK``, ``TPU.PREFETCH_DEPTH``: as in the JAX package;
* ``TPU.REMAT``: MaPLe runs each block of both towers under
  ``torch.utils.checkpoint`` (recomputed in the backward), as the JAX
  package's ``jax.checkpoint``;
* ``TPU.DATA_PARALLEL``: with more than one visible device, the batch is
  split over them and the gradients averaged on the trainer's device (the
  reference's ``nn.DataParallel``); nothing to do on one device;
* ``TPU.DATA_PARALLEL_MULTIHOST``: under ``torch.distributed`` with more
  than one process, each process's batch is its shard and the gradients are
  all-reduced (``engine/trainer.py``); without it such processes train
  alone, as in the JAX package;
* ``TPU.MESH_SHAPE``, ``TPU.MESH_AXES``: the client mesh of
  ``FED.PARALLEL_CLIENTS`` (``parallel/mesh.py``); ``TPU.FED_STEP_IMPL``
  (``auto``, ``vmap``, ``shard_map``): how its step spreads a client over
  its group's devices (``parallel/fedavg.py``);
* ``TRAIN.PROFILE_DIR``: each epoch traced with ``torch.profiler`` into it
  (``utils/profiling.py``);
* ``TRAIN.CHECKPOINT_BACKEND orbax``: as the JAX package where orbax is not
  importable (``trainers/maple_fed.py``); the single-site trainers ignore it;
* ``TPU.DONATE_BUFFERS``: nothing to do; the port's functional step makes
  new parameter and optimizer tensors each step and drops the old ones.
"""

from federated_multi_modal_tpu_torch.config.cfgnode import CfgNode as CN


def get_cfg_default() -> CN:
    cfg = CN()

    cfg.VERSION = 1
    cfg.OUTPUT_DIR = "./output"
    cfg.RESUME = ""
    cfg.SEED = -1
    cfg.USE_CUDA = True  # accepted for CLI compatibility; ignored on TPU
    cfg.VERBOSE = True

    # ------------------------------------------------------------------ input
    cfg.INPUT = CN()
    cfg.INPUT.SIZE = (224, 224)
    cfg.INPUT.INTERPOLATION = "bicubic"
    cfg.INPUT.TRANSFORMS = ()
    cfg.INPUT.NO_TRANSFORM = False
    cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
    cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
    cfg.INPUT.CROP_PADDING = 4
    cfg.INPUT.RRCROP_SCALE = (0.08, 1.0)
    cfg.INPUT.CUTOUT_N = 1
    cfg.INPUT.CUTOUT_LEN = 16
    cfg.INPUT.GN_MEAN = 0.0
    cfg.INPUT.GN_STD = 0.15
    cfg.INPUT.RANDAUGMENT_N = 2
    cfg.INPUT.RANDAUGMENT_M = 10
    cfg.INPUT.COLORJITTER_B = 0.4
    cfg.INPUT.COLORJITTER_C = 0.4
    cfg.INPUT.COLORJITTER_S = 0.4
    cfg.INPUT.COLORJITTER_H = 0.1
    cfg.INPUT.RGS_P = 0.2
    cfg.INPUT.GB_P = 0.5
    cfg.INPUT.GB_K = 21
    # TPU-first input pipeline: "device" = host decodes to uint8 canvas,
    # fused crop/flip/normalize on device; "host" = torchvision-equivalent
    # PIL pipeline (exact parity, slow).
    cfg.INPUT.PIPELINE = "device"
    cfg.INPUT.CANVAS_SIZE = 256
    # "shorter_crop" = aspect-preserving EVAL canvas (Resize(shorter)+
    # CenterCrop geometry, matching the reference eval pipeline); training
    # canvases always keep the full frame so the on-device RRC matches the
    # reference's full-frame torchvision RRC coverage.  "squash" stretches
    # the full frame into the square canvas for eval too.
    cfg.INPUT.CANVAS_MODE = "shorter_crop"
    # Use the native C++ decode library (libjpeg DCT-prescale + libpng +
    # PIL-equivalent resampling, federated_multi_modal_tpu_torch/native/) for the
    # device pipeline's host half; falls back to PIL per-file on failure.
    cfg.INPUT.NATIVE_DECODE = True

    # ---------------------------------------------------------------- dataset
    cfg.DATASET = CN()
    cfg.DATASET.ROOT = ""
    cfg.DATASET.NAME = ""
    cfg.DATASET.SOURCE_DOMAINS = ()
    cfg.DATASET.TARGET_DOMAINS = ()
    cfg.DATASET.NUM_LABELED = -1
    cfg.DATASET.NUM_SHOTS = -1
    cfg.DATASET.VAL_PERCENT = 0.1
    cfg.DATASET.STL10_FOLD = -1
    cfg.DATASET.CIFAR_C_TYPE = ""
    cfg.DATASET.CIFAR_C_LEVEL = 1
    cfg.DATASET.ALL_AS_UNLABELED = False
    cfg.DATASET.SUBSAMPLE_CLASSES = "all"  # all / base / new

    # ------------------------------------------------------------- dataloader
    cfg.DATALOADER = CN()
    cfg.DATALOADER.NUM_WORKERS = 4
    cfg.DATALOADER.K_TRANSFORMS = 1
    cfg.DATALOADER.RETURN_IMG0 = False
    # cache decoded uint8 canvases in RAM (device pipeline): augmentation
    # runs on device, so epoch 2+ needs no host JPEG decoding
    cfg.DATALOADER.CANVAS_CACHE = True
    # host-RAM budget for the canvas cache; past it, samples decode per
    # epoch (ImageNet-scale splits don't fit in RAM)
    cfg.DATALOADER.CANVAS_CACHE_BUDGET_GB = 4.0
    cfg.DATALOADER.TRAIN_X = CN()
    cfg.DATALOADER.TRAIN_X.SAMPLER = "RandomSampler"
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 32
    cfg.DATALOADER.TRAIN_X.N_DOMAIN = 0
    cfg.DATALOADER.TRAIN_X.N_INS = 16
    cfg.DATALOADER.TRAIN_U = CN()
    cfg.DATALOADER.TRAIN_U.SAME_AS_X = True
    cfg.DATALOADER.TRAIN_U.SAMPLER = "RandomSampler"
    cfg.DATALOADER.TRAIN_U.BATCH_SIZE = 32
    cfg.DATALOADER.TRAIN_U.N_DOMAIN = 0
    cfg.DATALOADER.TRAIN_U.N_INS = 16
    cfg.DATALOADER.TEST = CN()
    cfg.DATALOADER.TEST.SAMPLER = "SequentialSampler"
    cfg.DATALOADER.TEST.BATCH_SIZE = 32

    # ------------------------------------------------------------------ model
    cfg.MODEL = CN()
    cfg.MODEL.INIT_WEIGHTS = ""
    cfg.MODEL.NUM_CLASSES = 0
    cfg.MODEL.BACKBONE = CN()
    cfg.MODEL.BACKBONE.NAME = "ViT-B/16"
    cfg.MODEL.BACKBONE.PRETRAINED = True
    cfg.MODEL.BACKBONE.WEIGHTS_PATH = ""  # local OpenAI CLIP .pt / .npz
    cfg.MODEL.HEAD = CN()
    cfg.MODEL.HEAD.NAME = ""
    cfg.MODEL.HEAD.HIDDEN_LAYERS = ()
    cfg.MODEL.HEAD.ACTIVATION = "relu"
    cfg.MODEL.HEAD.BN = True
    cfg.MODEL.HEAD.DROPOUT = 0.0

    # ------------------------------------------------------------------ optim
    cfg.OPTIM = CN()
    cfg.OPTIM.NAME = "sgd"
    cfg.OPTIM.LR = 0.0003
    cfg.OPTIM.WEIGHT_DECAY = 5e-4
    cfg.OPTIM.MOMENTUM = 0.9
    cfg.OPTIM.SGD_DAMPNING = 0
    cfg.OPTIM.SGD_NESTEROV = False
    cfg.OPTIM.RMSPROP_ALPHA = 0.99
    cfg.OPTIM.ADAM_BETA1 = 0.9
    cfg.OPTIM.ADAM_BETA2 = 0.999
    cfg.OPTIM.STAGED_LR = False
    cfg.OPTIM.NEW_LAYERS = ()
    cfg.OPTIM.BASE_LR_MULT = 0.1
    cfg.OPTIM.LR_SCHEDULER = "single_step"
    cfg.OPTIM.STEPSIZE = (-1, )
    cfg.OPTIM.GAMMA = 0.1
    cfg.OPTIM.MAX_EPOCH = 10
    cfg.OPTIM.WARMUP_EPOCH = -1
    cfg.OPTIM.WARMUP_TYPE = "linear"
    cfg.OPTIM.WARMUP_CONS_LR = 1e-5
    cfg.OPTIM.WARMUP_MIN_LR = 1e-5
    cfg.OPTIM.WARMUP_RECOUNT = True
    # 0 = no clipping, matching the Dassl trainers (CoOp/CoCoOp/VPT/IVLP
    # run plain backward+step).  MaPLe is the ONLY reference trainer that
    # clips (hard-coded max-norm 1.0, maple.py:577) and forces it at the
    # trainer level (GRAD_CLIP_OVERRIDE), not through this knob.
    cfg.OPTIM.GRAD_CLIP_NORM = 0.0

    # ------------------------------------------------------------------ train
    cfg.TRAIN = CN()
    cfg.TRAIN.CHECKPOINT_FREQ = 0
    cfg.TRAIN.PRINT_FREQ = 10
    cfg.TRAIN.COUNT_ITER = "train_x"
    cfg.TRAIN.PROFILE_DIR = ""  # jax.profiler trace output (empty = off)
    # "pickle" keeps the reference's model.pth.tar contract; "orbax" stores
    # per-round federated aggregator checkpoints as async atomic
    # tensorstore pytrees (preemptible TPU deployments)
    cfg.TRAIN.CHECKPOINT_BACKEND = "pickle"

    # ------------------------------------------------------------------- test
    cfg.TEST = CN()
    cfg.TEST.EVALUATOR = "Classification"
    cfg.TEST.PER_CLASS_RESULT = False
    cfg.TEST.COMPUTE_CMAT = False
    cfg.TEST.NO_TEST = False
    cfg.TEST.SPLIT = "test"
    cfg.TEST.FINAL_MODEL = "last_step"

    # ---------------------------------------------------------------- trainer
    cfg.TRAINER = CN()
    cfg.TRAINER.NAME = ""

    cfg.TRAINER.COOP = CN()
    cfg.TRAINER.COOP.N_CTX = 16
    cfg.TRAINER.COOP.CSC = False
    cfg.TRAINER.COOP.CTX_INIT = ""
    cfg.TRAINER.COOP.PREC = "fp16"  # fp16/amp map to bf16 on TPU
    cfg.TRAINER.COOP.CLASS_TOKEN_POSITION = "end"

    cfg.TRAINER.COCOOP = CN()
    cfg.TRAINER.COCOOP.N_CTX = 16
    cfg.TRAINER.COCOOP.CTX_INIT = ""
    cfg.TRAINER.COCOOP.PREC = "fp16"

    cfg.TRAINER.MAPLE = CN()
    cfg.TRAINER.MAPLE.N_CTX = 2
    cfg.TRAINER.MAPLE.CTX_INIT = "a photo of a"
    cfg.TRAINER.MAPLE.PREC = "fp16"
    cfg.TRAINER.MAPLE.PROMPT_DEPTH = 9
    # Deviation from reference (documented): the caption branch's attention
    # pooling + 512->768 projection are *trained parameters* here; the
    # reference re-creates them randomly every forward (clip/model.py:552-558).
    cfg.TRAINER.MAPLE.USE_CAPTIONS = True
    cfg.TRAINER.MAPLE.ALIGN_LAMBDA = 0.5  # alignment-loss weight (maple.py:371)

    cfg.TRAINER.IVLP = CN()
    cfg.TRAINER.IVLP.N_CTX_VISION = 2
    cfg.TRAINER.IVLP.N_CTX_TEXT = 2
    cfg.TRAINER.IVLP.CTX_INIT = "a photo of a"
    cfg.TRAINER.IVLP.PREC = "fp16"
    cfg.TRAINER.IVLP.PROMPT_DEPTH_VISION = 9
    cfg.TRAINER.IVLP.PROMPT_DEPTH_TEXT = 9

    cfg.TRAINER.VPT = CN()
    cfg.TRAINER.VPT.N_CTX_VISION = 2
    cfg.TRAINER.VPT.CTX_INIT = "a photo of a"
    cfg.TRAINER.VPT.PREC = "fp16"
    cfg.TRAINER.VPT.PROMPT_DEPTH_VISION = 1

    # -------------------------------------------------------------- federated
    cfg.FED = CN()
    cfg.FED.NUM_CLIENTS = 2
    cfg.FED.NUM_ROUNDS = 30
    cfg.FED.LOCAL_EPOCHS = 10
    # Map clients onto a mesh axis and run them genuinely in parallel
    # (replaces the reference's sequential client loop, maple_fed.py:247-260)
    cfg.FED.PARALLEL_CLIENTS = False
    cfg.FED.DATASETS = ("PatternNet", "Ucmerced")
    cfg.FED.CLASSNAME_ONLY_DATASETS = ("EuroSAT", )
    # preemption safety on TPU slices: checkpoint the aggregator every
    # round and resume from the newest round checkpoint (SURVEY §5)
    cfg.FED.CHECKPOINT_EVERY_ROUND = False

    # --------------------------------------------------------------------- tpu
    cfg.TPU = CN()
    cfg.TPU.MESH_SHAPE = ()          # e.g. (2, 4) -> ("client", "data")
    cfg.TPU.MESH_AXES = ("client", "data")
    cfg.TPU.DONATE_BUFFERS = True
    # single-site DP over all visible devices (nn.DataParallel analog,
    # reference trainers/maple.py:510-514): replicate params, shard batches
    cfg.TPU.DATA_PARALLEL = True
    # opt-in: extend single-site DP across jax processes (global "data"
    # mesh; each process feeds its local batch as its shard, grads
    # all-reduce over DCN).  Off by default because the federated
    # trainers have their own cross-process semantics (parallel/fedavg.py)
    cfg.TPU.DATA_PARALLEL_MULTIHOST = False
    # "auto": packed-QKV Pallas kernels on TPU (1.6x train step at ViT-B/16
    # vision shapes), XLA elsewhere; "pallas"/"xla" force one implementation
    cfg.TPU.ATTENTION_IMPL = "auto"
    cfg.TPU.REMAT = False  # rematerialize blocks (bigger batches)
    # sequence-pack short text prompts (128 // T per attention row under a
    # block-diagonal causal mask; exact same per-sequence math) — 1.086x
    # end-to-end on the MaPLe step at 1000 classes (docs/BENCH.md)
    cfg.TPU.TEXT_PACK = True
    cfg.TPU.PREFETCH_DEPTH = 2
    # client-axis strategy for the parallel federated step: "shard_map"
    # runs each client group's UNBATCHED step on its data shard with an
    # explicit pmean over "data" (collectives ride ICI by construction);
    # "vmap" batches the client axis and lets GSPMD partition it; "auto"
    # picks shard_map on multi-device meshes when shapes divide evenly
    cfg.TPU.FED_STEP_IMPL = "auto"

    return cfg

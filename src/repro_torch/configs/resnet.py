"""ResNet-50/101/152 — the paper's own benchmark architectures.

[He et al. 2016] Bottleneck ResNets: the models Tables 1 and 3-6 of the
paper are measured on, field for field the reference's configs.  f32
activations and weights, 224 x 224 images, 1,000 classes.
"""
from repro_torch.configs.base import FAMILY_RESNET, ModelConfig, ParallelConfig
from repro_torch.configs.registry import ArchEntry, register


def _cfg(name: str, blocks) -> ModelConfig:
    return ModelConfig(
        name=name,
        family=FAMILY_RESNET,
        resnet_stage_blocks=tuple(blocks),
        resnet_width=64,
        num_classes=1000,
        img_size=224,
        dtype="float32",
    )


RESNET50 = _cfg("resnet50", (3, 4, 6, 3))
RESNET101 = _cfg("resnet101", (3, 4, 23, 3))
RESNET152 = _cfg("resnet152", (3, 8, 36, 3))

SMOKE = ModelConfig(
    name="resnet-smoke",
    family=FAMILY_RESNET,
    resnet_stage_blocks=(1, 1, 1, 1),
    resnet_width=16,
    num_classes=10,
    img_size=32,
    dtype="float32",
)


def _parallel(kind: str) -> ParallelConfig:
    return ParallelConfig()


for _name, _full in (("resnet50", RESNET50), ("resnet101", RESNET101),
                     ("resnet152", RESNET152)):
    register(ArchEntry(name=_name, full=_full, smoke=SMOKE, parallel=_parallel,
                       notes="paper's own arch; Tucker-2 LRD path"))

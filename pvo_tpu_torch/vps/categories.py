"""Virtual KITTI 2 panoptic category metadata (the port's own copy of
:mod:`pvo_tpu.vps.categories`).

Mirrors reference VPS_Module/detectron2/data/datasets/builtin_meta.py:
250-265 and the contiguous-id maps of others.py:18-39: 11 stuff classes
(trainIds 1..11) and 3 thing classes (Truck 12, Car 13, Van 14).
"""

VKITTI_CATEGORIES = [
    {"id": 0, "trainId": 1, "isthing": 0, "name": "Terrain",
     "color": [210, 0, 200]},
    {"id": 1, "trainId": 2, "isthing": 0, "name": "Sky",
     "color": [90, 200, 255]},
    {"id": 2, "trainId": 3, "isthing": 0, "name": "Tree",
     "color": [0, 199, 0]},
    {"id": 3, "trainId": 4, "isthing": 0, "name": "Vegetation",
     "color": [90, 240, 0]},
    {"id": 4, "trainId": 5, "isthing": 0, "name": "Building",
     "color": [140, 140, 140]},
    {"id": 5, "trainId": 6, "isthing": 0, "name": "Road",
     "color": [100, 60, 100]},
    {"id": 6, "trainId": 7, "isthing": 0, "name": "GuardRail",
     "color": [250, 100, 255]},
    {"id": 7, "trainId": 8, "isthing": 0, "name": "TrafficSign",
     "color": [255, 255, 0]},
    {"id": 8, "trainId": 9, "isthing": 0, "name": "TrafficLight",
     "color": [200, 200, 0]},
    {"id": 9, "trainId": 10, "isthing": 0, "name": "Pole",
     "color": [255, 130, 0]},
    {"id": 10, "trainId": 11, "isthing": 0, "name": "Misc",
     "color": [80, 80, 80]},
    {"id": 11, "trainId": 12, "isthing": 1, "name": "Truck",
     "color": [160, 60, 60]},
    {"id": 12, "trainId": 13, "isthing": 1, "name": "Car",
     "color": [255, 127, 80]},
    {"id": 13, "trainId": 14, "isthing": 1, "name": "Van",
     "color": [0, 139, 139]},
]

THING_TRAIN_IDS = [c["trainId"] for c in VKITTI_CATEGORIES
                   if c["isthing"] == 1]
STUFF_TRAIN_IDS = [c["trainId"] for c in VKITTI_CATEGORIES
                   if c["isthing"] == 0]

# contiguous <-> dataset (trainId) maps, as the reference builds them
THING_ID2CAT = {i: k for i, k in enumerate(THING_TRAIN_IDS)}
STUFF_ID2CAT = {i + 1: k for i, k in enumerate(STUFF_TRAIN_IDS)}
THING_CAT2ID = {k: i for i, k in THING_ID2CAT.items()}
STUFF_CAT2ID = {k: i for i, k in STUFF_ID2CAT.items()}

NUM_THING_CLASSES = len(THING_TRAIN_IDS)        # 3
NUM_SEMSEG_CLASSES = len(STUFF_TRAIN_IDS) + 1   # 12 (0 = thing/other)

"""Dataset builders: raw captures, image directories and videos into the
layouts the loader reads (a COCO ``labels.json`` beside ``frames/``, the npz
saved dataset, VIRAT's JSONL frame records).

Counterparts of ``trustedai_cl_vae_ad_tpu/data/builders/``; host code only,
no device. The root scripts ``build_raite_json_from_directory_torch.py``,
``fix_raite_event_data_torch.py``, ``build_veri_dataset_torch.py``,
``build_virat_dataset_torch.py`` and ``coco_validator_torch.py`` call them.
"""

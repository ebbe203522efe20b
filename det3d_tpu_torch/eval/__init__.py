"""Offline evaluation: KITTI-protocol AP over BEV and 3-D rotated IoU."""

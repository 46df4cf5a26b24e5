"""Small shared utilities (reference utils.py capability)."""

from __future__ import annotations



def put_text(im, text, bbox, box_color=(0, 255, 0)):
    """Draw a labeled box with a filled text banner (reference utils.py:25-33)."""
    import cv2
    cv2.rectangle(im, (int(bbox[0]), int(bbox[1])), (int(bbox[2]), int(bbox[3])),
                  color=box_color, thickness=1)
    font, scale, thick = cv2.FONT_HERSHEY_PLAIN, 0.6, 1
    (tw, th), _ = cv2.getTextSize(text, font, scale, thick)
    cv2.rectangle(im, (int(bbox[0]), int(bbox[1]) - th), (int(bbox[0]) + tw, int(bbox[1])),
                  color=(128, 0, 0), thickness=-1)
    cv2.putText(im, text, (int(bbox[0]), int(bbox[1])), fontFace=font, fontScale=scale,
                color=(255, 255, 255), thickness=thick)
    return im
